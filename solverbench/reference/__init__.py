"""The plain reference: torch sparse CSR, numpy and scipy, and
nothing of the program."""
