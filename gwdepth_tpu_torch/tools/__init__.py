"""Host-side tools of the port."""
