"""AdamW over the parameter dict."""
