"""Evaluation metrics (numpy)."""
