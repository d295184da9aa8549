from .io import (AsyncCheckpointer, load_pytree,  # noqa: F401
                 save_pytree)
