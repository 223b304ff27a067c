"""Device selection and weight interchange with the JAX package."""
