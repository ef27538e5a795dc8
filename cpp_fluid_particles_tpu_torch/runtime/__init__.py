"""Native host components of the port: the GIF encoder (native.py)."""
