"""The least time of a kernel's operation on the card, one formula a
file, against the peaks of `bench/peaks.json`."""
