"""Host-side decomposition of the mesh (numpy)."""
