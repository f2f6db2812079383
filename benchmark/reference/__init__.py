"""The plain reference: the answers of a window's requests worked out in
NumPy from the generated columns alone.  It imports nothing of the
program."""
