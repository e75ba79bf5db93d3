"""Submodular objectives, constraints, the greedy loop and GreeDi."""
