"""The training step, its optimizer, EMA, learning-rate schedules and
checkpoints."""
