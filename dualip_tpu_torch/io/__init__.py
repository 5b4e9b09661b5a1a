"""Host-side I/O helpers of the port (the native Benes router binding)."""
