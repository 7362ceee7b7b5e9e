"""Scene configs as data."""
