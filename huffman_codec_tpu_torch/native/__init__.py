"""Host C++ runtime of the v1 and v2 formats, bound with ctypes."""
