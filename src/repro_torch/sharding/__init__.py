"""Distribution over ``torch.distributed``: logical-axis partitioning,
pipeline stages and compressed gradient reduction."""
