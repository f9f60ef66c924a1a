"""Peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet, SXM
column, at the 700 W power limit): 3.35 TB/s of HBM3 bandwidth.  A card
set below 700 W runs slower under load; the result line carries the card's
name, and shares are stated against this published peak.
"""
H100_HBM_BYTES_PER_S = 3.35e12
