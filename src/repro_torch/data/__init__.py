"""Synthetic corpora and GreeDi coreset selection as global indices."""
