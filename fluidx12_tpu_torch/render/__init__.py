"""Fast render stack: light-map sweep, slice-composited cube march, resolve."""
