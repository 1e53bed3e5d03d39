"""Host-side helpers of the port (numpy and threading only)."""
