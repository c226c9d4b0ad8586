"""Core numerics of the port: binarization, BA-CAM scoring, two-stage
top-k, paged attention and the attention-backend registry."""
