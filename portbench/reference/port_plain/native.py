"""Stand-in for the program's native host-ops library: this copy has none,
so the finalize takes its NumPy paths (the program's tests hold those equal
to the native ones)."""


def load_hostops():
    return None
