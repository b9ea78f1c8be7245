"""Model helpers of the port: node embeddings and the softmax loss."""
