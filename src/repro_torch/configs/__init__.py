"""Architecture configurations (copies of the JAX package's dataclasses)."""
