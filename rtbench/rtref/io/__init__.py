"""The linear inputs' container."""
