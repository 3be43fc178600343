"""Device ops of the port: color, DCT, quant tables, the DCT+quant kernel."""
