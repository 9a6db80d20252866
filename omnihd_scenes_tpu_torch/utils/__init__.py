"""Host-side helpers of the port: quaternions and camera rigs (NumPy),
timing and device traces."""
