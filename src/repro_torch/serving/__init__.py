from .client import ReductionClient  # noqa: F401
from .engine import (  # noqa: F401
    KVPageStore,
    Request,
    ServingEngine,
    compress_kv_cache,
    decompress_kv_cache,
    park_kv_cache_async,
)
from .protocol import (  # noqa: F401
    MAX_FRAME_BYTES,
    PROTOCOL_VERSION,
    Frame,
    ProtocolError,
    encode_frame,
    parse_frame,
)
from .server import ReductionServer  # noqa: F401
from .service import (  # noqa: F401
    BULK,
    INTERACTIVE,
    OVERLOAD_POLICIES,
    PRIORITIES,
    ReductionService,
    ServiceOverloaded,
    ServiceStats,
)
