"""Serving layer (torch): MCP stdio JSON-RPC server and HTTP server."""
