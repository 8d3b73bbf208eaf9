"""The loss and the eval stack of the trainable model."""
