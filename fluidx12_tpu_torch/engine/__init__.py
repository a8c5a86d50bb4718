"""The application engine (FluidXEngine)."""
