"""Core attention API and the online-softmax state algebra."""
