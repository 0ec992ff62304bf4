from .cluster import RequestTrace, ServeCluster, SessionRecord
from .server import Replica, Request, SessionRouter, session_key

__all__ = ["Replica", "Request", "RequestTrace", "ServeCluster",
           "SessionRecord", "SessionRouter", "session_key"]
