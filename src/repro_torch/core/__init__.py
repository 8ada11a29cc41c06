"""Core watermark and PRF substrate of the port."""
