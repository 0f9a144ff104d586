"""The config machinery the training step needs: ``strtobool``,
``resolve_proto`` (``proto/`` of this package), the model DSL parser and
the chunk-config stream parser. The rest of the JAX package's
``config/`` (proto validation, chunk lists and configs, CLI overrides)
comes with the pipeline slice."""
