"""Config, state and host-side camera/LOD math (numpy + torch)."""
