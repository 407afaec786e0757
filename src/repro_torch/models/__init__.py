"""Models of the port: the language-model backbone on one device."""
