"""K1's share of its roofline, read in the recording cell (``readers.k1_roofline``)."""

from benchlib.readers import k1_roofline as read  # noqa: F401
