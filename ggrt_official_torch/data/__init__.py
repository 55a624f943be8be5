"""Host-side batch shims and synthetic scenes (numpy)."""
