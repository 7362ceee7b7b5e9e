"""Contact generation for the v2 engine."""
