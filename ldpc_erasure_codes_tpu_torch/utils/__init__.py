"""Device selection and verification."""
