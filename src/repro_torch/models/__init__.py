"""Models: the stacked field embedding, shared layers and DLRM."""
