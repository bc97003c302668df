"""Device scopes: one device for now; multi-GPU scopes come with the parallel slice."""
