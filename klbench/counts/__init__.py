"""Frozen operation and byte counts, and the card's published peaks.

These are the yardstick the rooflines and MFU divide by. They are copies,
not imports: a change to a kernel or to its workload hook in the program
does not move them. Each formula names the program's line it was copied
from, as it stood when the benchmark was written.
"""
