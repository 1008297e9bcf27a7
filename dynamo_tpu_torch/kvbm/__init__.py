"""KV block manager tiers of the port: G2 host memory, G3 disk, G4 objects,
the int8 tier codec and router-hinted prefetch."""
