"""core: the metadata engine (``remap``) and the policy layer (``policy``)."""
