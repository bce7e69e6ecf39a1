"""The real serving engine of the port: ``engine.MiniEngine``."""
