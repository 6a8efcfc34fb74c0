"""Host-side helpers: index unpacking and phase timing."""
