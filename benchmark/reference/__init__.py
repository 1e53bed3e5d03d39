"""The plain references the benchmark judges the port by: plain PyTorch,
importing nothing of the port, of JAX or of the repository's tests.  One
module per model kind (``fm``, ``deepfm``), found by the configuration's
``model`` key; ``common`` holds what they share."""
