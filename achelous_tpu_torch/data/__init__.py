"""Batches in the training layout (synthetic, from a numpy seed)."""
