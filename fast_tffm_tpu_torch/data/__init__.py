"""Host-side input: libsvm parsing and feature-id hashing (numpy only)."""
