"""Host-side utilities (varints, shared helpers)."""
