"""The generalized-coordinate pipeline (MuJoCo-style), batch-first."""
