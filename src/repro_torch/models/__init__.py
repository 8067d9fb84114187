"""Model zoo of the port: configs, layers, attention and the dense decoder."""
