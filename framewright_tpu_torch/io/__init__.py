"""Host-side media I/O: Y4M reading/writing and the frame rings."""
