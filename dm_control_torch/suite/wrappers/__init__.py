"""Environment wrappers of the suite: action noise and scale, the
profiling wrapper, and pixel observations (``pixels``)."""
