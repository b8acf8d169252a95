"""Device operators: push supersteps, the destination-row gather, top-k
and walks."""
