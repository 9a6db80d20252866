"""Host-side helpers (NumPy) of the port."""
