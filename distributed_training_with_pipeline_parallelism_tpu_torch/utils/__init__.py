"""Configuration, device selection and weight loading."""
