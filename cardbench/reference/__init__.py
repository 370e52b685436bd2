"""The benchmark's plain references: Python integers, hashlib and numpy
only, nothing of the program under test."""
