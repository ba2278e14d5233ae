"""Batches in the training layout: synthetic ones from a numpy seed, and the
WaterScenes pipeline (dataset, augmentation, collate, prefetch)."""
