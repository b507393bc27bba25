"""Model definitions of the port (RRDBNet in slice 1)."""
