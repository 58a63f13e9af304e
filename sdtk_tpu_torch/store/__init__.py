"""The file database: the JAX package's ``$SPEAKERS_EMBEDDINGS_DIR`` layout
(``db/{id}.json`` profiles, ``embeddings/{emb-id}.npy`` vectors,
``samples/{speaker}/`` metadata, ``catalog/{b3sum}.yaml`` recordings,
``assignments/{b3sum}.yaml``, ``contexts.yaml``, ``process_queue.yaml``),
with atomic writes."""
