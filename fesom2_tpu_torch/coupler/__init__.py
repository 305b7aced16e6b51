"""The OASIS3-MCT stand-in: the send/receive driver, the conservative
flux correction and the socket transport (the port of
``fesom2_tpu/coupler``)."""
from .oasis import (CplDriver, InMemoryTransport, force_flux_consv,
                    SEND_FIELDS_ECHAM, SEND_FIELDS_OIFS, RECV_FIELDS_ECHAM,
                    RECV_FIELDS_OIFS)
from .transport import OasisEndpoint, SocketTransport

__all__ = ["CplDriver", "InMemoryTransport", "force_flux_consv",
           "SEND_FIELDS_ECHAM", "SEND_FIELDS_OIFS", "RECV_FIELDS_ECHAM",
           "RECV_FIELDS_OIFS", "OasisEndpoint", "SocketTransport"]
