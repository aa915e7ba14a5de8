"""The plain versions of the port's kernels (see rtref/__init__.py)."""
