"""Server plane of the port: the reduced websocket data server and its entry point."""
