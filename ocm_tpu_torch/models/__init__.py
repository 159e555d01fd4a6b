"""One-class models."""
