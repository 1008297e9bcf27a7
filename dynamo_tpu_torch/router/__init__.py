"""Request routing of the port: the KV router and the disaggregation router."""
