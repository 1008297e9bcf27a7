"""KV block manager tiers of the port (G2 host pool)."""
