"""The file database the identify path reads and writes: the JAX package's
``$SPEAKERS_EMBEDDINGS_DIR`` layout (``db/{id}.json`` profiles,
``embeddings/{emb-id}.npy`` vectors, ``samples/{speaker}/`` metadata),
with atomic writes."""
