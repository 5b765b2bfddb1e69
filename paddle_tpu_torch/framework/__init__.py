"""Framework pieces of the Paddle API: dtypes, places, the random state,
parameters and ``save`` / ``load`` (``framework/io.py``)."""

from . import dtype, place, random  # noqa: F401
