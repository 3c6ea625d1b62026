"""Serving: the text-to-image endpoint and its HTTP server."""
