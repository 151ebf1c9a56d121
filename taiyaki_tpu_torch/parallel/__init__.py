"""Data parallelism: the devices a batch is split over, and the training
process group (one process per card)."""
