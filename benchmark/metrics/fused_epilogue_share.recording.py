"""The fused share of the tower's epilogues in the recording cell: the batch
cells' reader (``fused_epilogue_share.batch``) on this cell's counters."""

from benchlib import manifest

read = manifest.module("metrics", "fused_epilogue_share.batch").read
