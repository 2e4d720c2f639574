"""User-facing classes of the port: MinHash bulk signatures and the index."""
