"""Host-side helpers of the port shared by crypto/ and ops/."""
