"""K1's share of its roofline, read in the batch cells (``readers.k1_roofline``)."""

from benchlib.readers import k1_roofline as read  # noqa: F401
