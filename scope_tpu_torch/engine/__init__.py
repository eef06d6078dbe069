"""Generation loops."""
