"""Environment wrappers of the suite (pixels waits for rendering,
ROADMAP A6)."""
