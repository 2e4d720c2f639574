"""Functional core of the port: hashing, MinHash signatures, LSH tables."""
