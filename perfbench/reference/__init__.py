"""The plain reference the served tokens are judged against."""
