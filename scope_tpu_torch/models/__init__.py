"""Model definitions and parameter conversion."""
