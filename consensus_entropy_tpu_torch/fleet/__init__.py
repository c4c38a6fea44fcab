"""The per-user session the AL loop steps through."""
