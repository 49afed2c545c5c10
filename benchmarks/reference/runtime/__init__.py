"""The pipeline's analysis, its host tail and the batch runner's chunk."""
