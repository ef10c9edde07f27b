"""Host-side volume I/O (``pointunet_tpu/data``): numpy only."""
