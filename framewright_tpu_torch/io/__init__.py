"""Host-side media I/O: Y4M, PNG frame directories, ffmpeg pipes, colour
conversion (``video`` chooses by suffix) and the frame rings."""
