"""Scale-out: device meshes, sharded pair batching, db-sharded kNN, collectives."""
