"""Command-line entry points: train and validate (main), generate, serve,
the VGG-16 fine-tune and inference, checkpoint conversion, the serving
export."""
