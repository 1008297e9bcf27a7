"""Request routing of the port (the disaggregation router)."""
