"""Small shared codecs and helpers of the port (no domain logic)."""
