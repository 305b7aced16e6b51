"""File input of the port (host numpy)."""
