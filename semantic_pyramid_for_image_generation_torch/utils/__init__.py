"""Device selection and the weight bridge from JAX parameters and reference `.pt` files."""
