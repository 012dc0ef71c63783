"""Model definitions: layers, attention with the paged cache, the stack."""
