"""Frame processors of the port (super-resolution in slice 1)."""
