"""The loss, the eval stack, the SGD steps and the training loop of the
trainable model."""
