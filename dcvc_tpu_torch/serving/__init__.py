from .client import CodecClient, ServerError
from .server import CodecServer

__all__ = ["CodecClient", "CodecServer", "ServerError"]
