"""Framework pieces of the Paddle API: dtypes, places, the random state and
parameters."""

from . import dtype, place, random  # noqa: F401
