"""Image helpers, and the tolerance the faithful stack is held to."""
