"""The two-tier paged KV store under Trimma metadata."""
